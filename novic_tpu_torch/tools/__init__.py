"""Offline and serving tools of the port (demo server, annotation and caption tooling)."""
