"""Errors the port's library raises for a caller's mistake."""

from __future__ import annotations


class BadRequest(ValueError):
    """A mistake in what the caller asked for, found by the library's own
    validation: files that cannot be combined, a model file the port
    cannot read, a parameter that cannot be recovered.  The server
    answers it with 400 wherever it is raised (`app/server.py` `_error`);
    any other exception raised inside the library is a fault of the
    server's side and answers 500."""
