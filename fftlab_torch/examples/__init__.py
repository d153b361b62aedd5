"""Small self-contained programs on the port (counterpart of examples/)."""
