"""Arrow table helpers (:mod:`.batching_table_queue`)."""
