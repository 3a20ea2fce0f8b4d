from guacamole_tpu_torch.pack.events import EventKind, read_pileup_events
from guacamole_tpu_torch.pack.tiles import LocusTile, pack_tile, pack_tiles
