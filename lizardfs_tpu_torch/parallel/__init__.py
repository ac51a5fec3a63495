"""Multi-device steps of the port: wide-stripe encode and rebuild over a
mesh of torch devices, driven from one process."""
