"""The listening socket a replica's HTTP server takes over from its parent.

A fleet controller that spawns a replica reserves the replica's port before
the child starts: it binds a socket to a free port (bound, not listening,
so a connect is refused as before the child serves, and no outgoing
connection can take the port as its local one) and hands it down
(``pass_fds``, its number in :data:`LISTEN_FD_ENV`).  The child's server
(:class:`ReservedPortServer`, the base of the serve and stream servers)
adopts it.  Binding port 0, closing it and letting the child bind the
number seconds later left the port free for anything that took an
ephemeral port meanwhile, and the child then died with ``EADDRINUSE``.

Torch-free: the router tier imports :data:`LISTEN_FD_ENV` from here.
"""

from __future__ import annotations

import os
import socket
from http.server import ThreadingHTTPServer
from typing import Optional

__all__ = ["LISTEN_FD_ENV", "reserved_socket", "ReservedPortServer"]

#: the environment variable that names a spawned replica's reserved socket
LISTEN_FD_ENV = "DFD_LISTEN_FD"


def reserved_socket(port: int) -> Optional[socket.socket]:
    """The socket a parent bound to ``port`` and handed down
    (``LISTEN_FD_ENV``), taken once; None when there is none for this
    port."""
    fd = os.environ.get(LISTEN_FD_ENV)
    if not fd:
        return None
    sock = socket.socket(fileno=int(fd))
    if sock.getsockname()[1] != int(port):
        sock.detach()
        return None
    del os.environ[LISTEN_FD_ENV]
    return sock


class ReservedPortServer(ThreadingHTTPServer):
    """A ``ThreadingHTTPServer`` that serves on the socket reserved for its
    port (:func:`reserved_socket`) when its parent reserved one, else binds
    its address as usual."""

    def server_bind(self):
        sock = reserved_socket(self.server_address[1])
        if sock is None:
            return super().server_bind()
        self.socket.close()
        self.socket = sock
        self.server_address = sock.getsockname()
        host, port = self.server_address[:2]
        self.server_name = socket.getfqdn(host)
        self.server_port = port
