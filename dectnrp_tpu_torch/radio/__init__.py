"""Radio layer of the port (see dectnrp_tpu/radio): the hardware
abstraction, gain LUTs and antenna arrays (copies) and the simulated radio
(`hw_simulator.py`). The real-IQ radios (`hw_iq.py`) are not ported."""
