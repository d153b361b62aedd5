"""Core types and host-built tables."""
