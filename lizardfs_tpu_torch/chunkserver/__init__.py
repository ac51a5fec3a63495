"""The chunkserver role of the PyTorch port: its chunk store and rebuild."""
