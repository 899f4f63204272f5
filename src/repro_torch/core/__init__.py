"""Host-side foundations of the port: address algebra, ring, delays."""
