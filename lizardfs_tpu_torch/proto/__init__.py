"""Protocol constants of the PyTorch port: its status codes."""
