"""Scene-file parsers used by the port (camera and material files)."""
