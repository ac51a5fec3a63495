"""Client: library-first file system access (liblizardfs-client analog)."""
