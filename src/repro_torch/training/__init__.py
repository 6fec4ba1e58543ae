"""Training substrate: AdamW, the train step, data, checkpointing."""
