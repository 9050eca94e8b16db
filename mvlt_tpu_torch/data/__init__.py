"""Data: tokenizer, text and image masking, the synthetic pre-training set."""
