"""Models of the port: EdgeNeXt and its parameter tree."""
