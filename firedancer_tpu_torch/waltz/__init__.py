"""waltz: networking protocols (ref: src/waltz/). The port holds the QUIC
door's two: TLS 1.3 (tls.py) and QUIC (quic.py)."""
