"""Transform algorithms in tensor ops."""
