"""Process and precision plumbing (slice 1: precision and device only)."""
