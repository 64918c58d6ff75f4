"""Shared stdlib-HTTP plumbing for the serve tier's servers."""

from __future__ import annotations

import sys


class QuietDisconnectsMixin:
    """ThreadingHTTPServer mixin: a peer vanishing mid keep-alive (a
    killed replica's client, a chaos test's abrupt close, the router
    dropping an upstream) is business as usual for a serving fleet —
    not a traceback. Real handler bugs still print."""

    def handle_error(self, request, client_address):
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionResetError, BrokenPipeError,
                            ConnectionAbortedError, TimeoutError)):
            return
        super().handle_error(request, client_address)
