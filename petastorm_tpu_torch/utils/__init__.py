"""Host-side helpers shared by the reader's workers."""
