"""Data planes of the port (numpy only; batches move to the device in the
trainer)."""
