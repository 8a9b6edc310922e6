"""Checkpoints: npz shards with an atomic manifest commit, and async saves."""
