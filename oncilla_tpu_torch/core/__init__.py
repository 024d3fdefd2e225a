"""Core: arenas, handles, the context."""
