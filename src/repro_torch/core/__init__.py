"""PTQ pipeline: calibrate → α-search → smooth → int4 RTN."""
