"""Master: metadata server — FS tree, chunk registry, changelog, health."""
