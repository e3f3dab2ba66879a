"""Model code of the port (dense decoder serving path)."""
