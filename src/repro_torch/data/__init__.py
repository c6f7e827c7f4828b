"""The bitmap-indexed training data pipeline."""
