"""Model code of the port. Only the RWKV6 recurrence (both WKV forms) is
ported so far; the backbones and their configs come with the LM side."""
