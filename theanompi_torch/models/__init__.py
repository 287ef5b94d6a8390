"""Models of the port (slice 1: the dense ``TransformerLM`` serving path)."""
