"""Device operators of the port (ops/ of the reference)."""
