"""Frozen work counts: what one call needs, from its shapes alone, never
from what the program runs. A later change to the program does not move
them."""
