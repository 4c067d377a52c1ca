"""Physics ops and the hand-written kernels they run on the card."""
