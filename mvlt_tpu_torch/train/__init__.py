"""Training: losses, LR schedule and AdamW, train state, the step and the epoch loop."""
