"""High availability: raft-style leader election + failover controller."""
