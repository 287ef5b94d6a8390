"""Data planes of the port: numpy only, apart from the prefetcher
(:mod:`.prefetch`), which places the batches on the trainer's device."""
