"""Serving: the web UI / JSON API (`server.py`) and the dynamic batcher
(`batcher.py`)."""
