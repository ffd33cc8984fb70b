"""Infrastructure layer (SURVEY.md L0): errors, logging, cursors, CRC, options, stats."""
