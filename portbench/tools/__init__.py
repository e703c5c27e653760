"""Tools that set the limits of `correct` from readings on the card."""
