"""Model zoo of the port (CARS so far)."""
