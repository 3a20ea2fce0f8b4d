from guacamole_tpu_torch.utils import bases, phred
from guacamole_tpu_torch.utils.progress import progress, DelayedMessages
