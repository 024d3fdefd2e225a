"""The port's control-plane client: the wire protocol, membership, the
connection pool, the daemon client, and the launcher of its own copy of the
native daemon (``runtime/native/``)."""
