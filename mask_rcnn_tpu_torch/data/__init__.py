"""Data helpers: static bucket shapes, mask bit-packing, synthetic train
batches."""
