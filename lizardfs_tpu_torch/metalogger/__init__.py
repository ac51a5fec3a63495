"""Metalogger: changelog archiver daemon (metadata disaster recovery)."""
