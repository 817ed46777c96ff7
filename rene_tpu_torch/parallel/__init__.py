"""Multi-device renders over torch.distributed (parallel/shard.py)."""
