"""Core data path: embedding engine, storage tier, key-centric clustering."""
