"""Multi-device placement rules and collectives over ``torch.distributed``."""
