"""The work of a restore counted from its shapes, and the card's peaks."""
