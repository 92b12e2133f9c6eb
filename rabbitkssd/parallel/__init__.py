"""Multi-device execution: meshes, shard_map pipelines, collectives."""
