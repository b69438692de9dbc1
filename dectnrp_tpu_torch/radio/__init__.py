"""Radio layer of the port (see dectnrp_tpu/radio): the hardware
abstraction, gain LUTs and antenna arrays (copies), the simulated radio
(`hw_simulator.py`) and the real-IQ radios (`hw_iq.py`, a copy: a cf32 file
or UDP IQ through the native ring, paced UDP or file egress)."""
