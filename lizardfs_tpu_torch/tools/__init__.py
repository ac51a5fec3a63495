"""User-facing CLIs: the `lizardfs` file tool and `lizardfs-admin`."""
