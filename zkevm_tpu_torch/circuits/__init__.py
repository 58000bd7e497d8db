"""Circuits of the port: KeccakTable and the toy circuits."""
