"""The multi-device four-step NTT of the port (``ntt_tpu.parallel``): a mesh
of D shards, on one card or several, the exchange through kernel K8."""

from .dist_ntt import (dist_intt, dist_lde, dist_ntt, exchange_options,
                       make_dist_ntt, make_mesh, shard_for_ntt, unshard)

__all__ = ["make_mesh", "make_dist_ntt", "dist_ntt", "dist_intt",
           "dist_lde", "exchange_options", "shard_for_ntt", "unshard"]
