"""Channel-layout conventions of the 84-channel ERA5 stack (the port's copy
of ``ladcast_tpu/channels.py``, as far as the port needs it): 6
atmospheric variables x 13 pressure levels (level-major within each
variable), then 6 surface variables. SST is global channel 82."""

from __future__ import annotations

from typing import List, Optional, Tuple

ATM_VARIABLES: Tuple[str, ...] = (
    "geopotential",
    "specific_humidity",
    "temperature",
    "u_component_of_wind",
    "v_component_of_wind",
    "vertical_velocity",
)

SURFACE_VARIABLES: Tuple[str, ...] = (
    "10m_u_component_of_wind",
    "10m_v_component_of_wind",
    "2m_temperature",
    "mean_sea_level_pressure",
    "sea_surface_temperature",
    "total_precipitation_6hr",
)

PRESSURE_LEVELS: Tuple[int, ...] = (
    50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000)

NUM_ATM_VARS = len(ATM_VARIABLES)
NUM_LEVELS = len(PRESSURE_LEVELS)
NUM_DYNAMIC_CHANNELS = NUM_ATM_VARS * NUM_LEVELS + len(SURFACE_VARIABLES)  # 84
STATIC_NAMES: Tuple[str, ...] = (  # the DCAE's reconstructed statics
    "land_sea_mask", "oro_1", "oro_2", "oro_3", "oro_4")

# Grid: 1.5 deg, south-pole row cropped.
LAT_START_DEG = -88.5
LAT_END_DEG = 90.0
LON_START_DEG = 0.0
LON_END_DEG = 358.5
INTERVAL_DEG = 1.5

SST_CHANNEL_INDEX = (NUM_ATM_VARS * NUM_LEVELS
                     + SURFACE_VARIABLES.index("sea_surface_temperature"))  # 82


def channel_names() -> List[str]:
    """The 84 channel names, ``var_level_{p}`` for atmospheric ones."""
    names = [f"{v}_level_{p}" for v in ATM_VARIABLES for p in PRESSURE_LEVELS]
    names.extend(SURFACE_VARIABLES)
    return names


def channel_index(var: str, level: Optional[int] = None) -> int:
    """The stack index of a variable (at a pressure level for the
    atmospheric ones); raises ValueError for an unknown name or level."""
    if var in ATM_VARIABLES:
        if level is None:
            raise ValueError(f"{var} needs a pressure level")
        return ATM_VARIABLES.index(var) * NUM_LEVELS + PRESSURE_LEVELS.index(level)
    if level is not None:
        raise ValueError(f"{var} has no pressure levels")
    return NUM_ATM_VARS * NUM_LEVELS + SURFACE_VARIABLES.index(var)
