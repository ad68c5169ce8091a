"""Host-side utilities of the port: own copies of what the engine calls."""
