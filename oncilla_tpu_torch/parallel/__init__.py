"""The fabric of device rows: mesh order and the row arena."""
