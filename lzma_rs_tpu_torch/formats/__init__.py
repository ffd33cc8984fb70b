"""Container/bitstream parsing layer (SURVEY.md L0/L3/L4): LZMA header, LZMA2 chunk scanner, .xz framing."""
