"""Reader internals: the row worker and the row shuffling buffer."""
