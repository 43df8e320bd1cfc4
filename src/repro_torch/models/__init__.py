"""Model code of the port: the dense decoder-only transformer's serving
paths (slot-ring and paged)."""
