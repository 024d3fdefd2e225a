"""The plain reference the served tokens are checked against."""
