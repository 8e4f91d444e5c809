"""The traffic kinds, one driver each, and what they read from data files."""
