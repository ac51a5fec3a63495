"""ChunkEncoder boundary and slice geometry of the port."""
