"""Subpackage of the PyTorch port: transcription, word alignment and diarized conversion."""
