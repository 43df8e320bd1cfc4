"""Model code of the port: the dense decoder-only transformer's paged
serving path."""
