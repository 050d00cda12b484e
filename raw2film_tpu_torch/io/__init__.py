"""Host edges of the port: the RAW decode to device XYZ and lens correction."""
