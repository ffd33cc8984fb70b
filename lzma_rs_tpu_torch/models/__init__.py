"""Decoder model layer (SURVEY.md L1/L2): flat probability state, executable spec (oracle), host codecs."""
