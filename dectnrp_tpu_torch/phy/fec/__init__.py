"""FEC of the port: turbo codec, BCJR kernel wrapper, PCC/PDC chains."""
