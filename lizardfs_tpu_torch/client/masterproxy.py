"""Local master proxy: tools inside a mount reach the master through it.

The analog of the reference's masterproxy module (reference:
src/mount/masterproxy.cc): the mount listens on a localhost port and
relays whole TCP streams to the current master, so CLI tools need only
the mount point — they read the proxy address from ``.masterinfo`` and
never have to know the cluster's master list or follow a failover.
"""

from __future__ import annotations

import asyncio


class MasterProxy:
    """Byte-level TCP relay to the (current) master address."""

    def __init__(self, master_addr_fn):
        """``master_addr_fn() -> (host, port)`` — called per connection
        so failover (the client tracking a new master) is picked up."""
        self.master_addr_fn = master_addr_fn
        self.port = 0
        self._server: asyncio.AbstractServer | None = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, "127.0.0.1", 0
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            try:
                # 3.12+ wait_closed also waits for live handlers; a
                # parked relay must not wedge or crash mount teardown
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                pass
            self._server = None

    async def _handle(self, reader, writer) -> None:
        host, port = self.master_addr_fn()
        try:
            # dial bound: a tool's connection must fail fast when the
            # advertised master is blackholed, like every other dial
            up_reader, up_writer = await asyncio.wait_for(
                asyncio.open_connection(host, port), 5.0
            )
        except (OSError, asyncio.TimeoutError):
            writer.close()
            return

        async def pump(src, dst):
            try:
                while True:
                    # lint: waive(unbounded-await): byte-level relay pump — parks on whichever side speaks next by design; liveness is owned by the two endpoints' own timeouts
                    data = await src.read(65536)
                    if not data:
                        break
                    dst.write(data)
                    # lint: waive(unbounded-await): relay backpressure mirrors the slower endpoint; a timer here would cut live slow tools
                    await dst.drain()
            except (ConnectionError, OSError):
                pass
            finally:
                try:
                    dst.close()
                except RuntimeError:
                    pass

        await asyncio.gather(
            pump(reader, up_writer), pump(up_reader, writer)
        )
