"""Flagship steps of the port: the chunk write and rebuild compute."""
