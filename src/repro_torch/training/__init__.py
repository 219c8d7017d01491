"""Training: AdamW, the train step, Raptor redundant-DP weights."""
