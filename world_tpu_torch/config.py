"""Option dataclasses and derived quantities (own copy; imports nothing
of the JAX package).

Mirrors the reference's per-algorithm option structs 1:1 (same fields,
same defaults): DioOption (src/world/dio.h:16-23), HarvestOption
(src/world/harvest.h:16-20),
CheapTrickOption (src/world/cheaptrick.h:16-20), D4COption
(src/world/d4c.h:16-18), constants (src/world/constantnumbers.h).
"""

import dataclasses
import math

# Global constants (reference src/world/constantnumbers.h:11-50).
K_CUT_OFF = 50.0
K_FLOOR_F0_STONEMASK = 40.0
K_PI = 3.1415926535897932384
K_MY_SAFE_GUARD_MINIMUM = 1e-12
K_EPS = 2.2204460492503131e-16
K_FLOOR_F0 = 71.0
K_CEIL_F0 = 800.0
K_DEFAULT_F0 = 500.0
K_LOG2 = 0.69314718055994529
K_MAXIMUM_VALUE = 100000.0
K_FREQUENCY_INTERVAL = 3000.0
K_UPPER_LIMIT = 15000.0
K_THRESHOLD = 0.85
K_FLOOR_F0_D4C = 47.0
K_SAFE_GUARD_D4C = 1e-6
K_M0 = 1127.01048
K_F0 = 700.0
K_FLOOR_FREQUENCY = 40.0
K_CEIL_FREQUENCY = 20000.0


def _pow2_from_log(value):
    """2 ** (1 + int(log2(value))) — the reference's fft-size recipe."""
    return int(2.0 ** (1 + int(math.log(value) / K_LOG2)))


@dataclasses.dataclass(frozen=True)
class DioOption:
    f0_floor: float = K_FLOOR_F0
    f0_ceil: float = K_CEIL_F0
    channels_in_octave: float = 2.0
    frame_period: float = 5.0
    speed: int = 1
    allowed_range: float = 0.1


@dataclasses.dataclass(frozen=True)
class HarvestOption:
    f0_floor: float = K_FLOOR_F0
    f0_ceil: float = K_CEIL_F0
    frame_period: float = 5.0


@dataclasses.dataclass(frozen=True)
class CheapTrickOption:
    q1: float = -0.15
    f0_floor: float = K_FLOOR_F0
    fft_size: int = 0  # 0 -> derived from fs at call time

    def resolve(self, fs):
        if self.fft_size:
            return self
        return dataclasses.replace(
            self, fft_size=get_fft_size_for_cheaptrick(fs, self.f0_floor))


@dataclasses.dataclass(frozen=True)
class D4COption:
    threshold: float = K_THRESHOLD


def get_fft_size_for_cheaptrick(fs, f0_floor=K_FLOOR_F0):
    """Reference src/cheaptrick.cpp:191-194."""
    return _pow2_from_log(3.0 * fs / f0_floor + 1)


def get_f0_floor_for_cheaptrick(fs, fft_size):
    """Reference src/cheaptrick.cpp:196-198."""
    return 3.0 * fs / (fft_size - 3.0)


def get_fft_size_for_d4c(fs):
    """Internal D4C fft size (reference src/d4c.cpp:350-352)."""
    return _pow2_from_log(4.0 * fs / K_FLOOR_F0_D4C + 1)


def get_fft_size_for_d4c_love_train(fs):
    """LoveTrain VUV-gate fft size (reference src/d4c.cpp:263-265)."""
    return _pow2_from_log(3.0 * fs / 40.0 + 1)


def get_number_of_aperiodicities(fs):
    """Reference src/codec.cpp:212-215."""
    return int(min(K_UPPER_LIMIT, fs / 2.0 - K_FREQUENCY_INTERVAL)
               / K_FREQUENCY_INTERVAL)


def get_samples_for_dio(fs, x_length, frame_period):
    """Reference src/dio.cpp:639-641 (same formula for Harvest)."""
    return int(1000.0 * x_length / fs / frame_period) + 1


get_samples_for_harvest = get_samples_for_dio
