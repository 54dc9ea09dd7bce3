"""Data helpers: static bucket shapes."""
