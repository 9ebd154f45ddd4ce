"""Serving loop (training lands in a later slice)."""
