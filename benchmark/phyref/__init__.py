"""A frozen, plain PyTorch copy of the port's DECT NR+ PHY: the benchmark's
yardstick.

It holds what the benchmark's references (sync, stream RX, PCC and PDC
decode, TX) need, copied from the port `dectnrp_tpu_torch` at the commit
that defined the benchmark, with every kernel replaced by its plain twin.
It imports nothing of the port, so a later change to the program does not
change the reference.
As in the port, TF32 is off: the GF(2) CRC products and the channel
estimation's einsums need full float32.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
