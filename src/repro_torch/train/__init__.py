"""Training: AdamW, the train step and the supervised training loop."""
