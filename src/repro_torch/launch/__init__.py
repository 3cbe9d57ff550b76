"""Launchers of the port: ``serve`` (batched greedy decoding)."""
