"""Tape server: archival whole-file copies for goals with a $tape slice.

The reference's tape support (src/master/matotsserv.cc + src/common/
tape_*, ~600 LoC) lets goals request copies on tape servers in addition
to disk replication. This package is the framework's tape daemon: it
registers with the master, receives "archive this file" commands, reads
the file through the normal client data path, and stores it in its
archive directory (the "tape library" — any cold medium mounted there).
"""

from lizardfs_tpu_torch.tapeserver.server import TapeServer

__all__ = ["TapeServer"]
