"""Encode side (SURVEY.md rows 13-17): range encoder, LZMA/LZMA2/.xz writers (native-accelerated)."""
