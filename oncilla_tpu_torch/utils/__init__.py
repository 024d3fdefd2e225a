"""Configuration, logging/span counters, device selection."""
