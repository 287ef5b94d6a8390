"""Models of the port: the dense ``TransformerLM`` (training and serving)
and its PTB-style data."""
