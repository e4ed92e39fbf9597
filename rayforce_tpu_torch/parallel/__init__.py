"""Multi-shard kernels over the engine's in-process device mesh."""
