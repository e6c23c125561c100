"""AdamW of the port (the JAX package's ``optim``)."""
from repro_torch.optim.adamw import adamw_update, init_opt_state, lr_schedule
