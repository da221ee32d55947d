"""On-device ops of the input tail, each backed by a hand-written kernel."""
