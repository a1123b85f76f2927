"""Offline tools over volume files."""
