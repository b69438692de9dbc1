"""TX synthesis, STF sync and aligned RX, frozen plain copies."""
