"""Host-side utilities of the port: the recorder, model import, batch
placement."""
