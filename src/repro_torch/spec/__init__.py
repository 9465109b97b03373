"""``repro_torch.spec`` — sampling shared by the serving engines.

Only the replay-safe sampler is ported so far; draft tiers and speculative
decoding come with a later slice of the port.
"""

from repro_torch.spec.sampling import ReplaySafeSampler, position_noise

__all__ = ["ReplaySafeSampler", "position_noise"]
