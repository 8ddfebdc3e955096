"""Errors for what the port does not serve yet."""


class NotPorted(NotImplementedError):
    """A flag value or code path that the JAX package serves and the port
    does not yet; the message names the ROADMAP.md item that ports it."""
