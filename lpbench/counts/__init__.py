"""FLOP and byte counts of the work a cell's inputs need, from shapes."""
