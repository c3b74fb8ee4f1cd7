"""Channel-layout conventions of the 84-channel ERA5 stack (the port's copy
of ``ladcast_tpu/channels.py``): 6
atmospheric variables x 13 pressure levels (level-major within each
variable), then 6 surface variables. SST is global channel 82."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

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

STATIC_VARIABLES: Tuple[str, ...] = (  # the ERA5 names of the statics
    "land_sea_mask",
    "standard_deviation_of_orography",
    "angle_of_sub_gridscale_orography",
    "anisotropy_of_sub_gridscale_orography",
    "slope_of_sub_gridscale_orography",
)

PRESSURE_LEVELS: Tuple[int, ...] = (
    50, 100, 150, 200, 250, 300, 400, 500, 600, 700, 850, 925, 1000)

NUM_ATM_VARS = len(ATM_VARIABLES)
NUM_SURFACE_VARS = len(SURFACE_VARIABLES)
NUM_LEVELS = len(PRESSURE_LEVELS)
NUM_DYNAMIC_CHANNELS = NUM_ATM_VARS * NUM_LEVELS + NUM_SURFACE_VARS  # 84
NUM_STATIC_CHANNELS = len(STATIC_VARIABLES)  # 5
STATIC_NAMES: Tuple[str, ...] = (  # the DCAE's reconstructed statics
    "land_sea_mask", "oro_1", "oro_2", "oro_3", "oro_4")

# Grid: 1.5 deg, south-pole row cropped.
LAT_START_DEG = -88.5
LAT_END_DEG = 90.0
LON_START_DEG = 0.0
LON_END_DEG = 358.5
INTERVAL_DEG = 1.5
GRID_LAT = 120
GRID_LON = 240
LATENT_LAT = 15
LATENT_LON = 30
LATENT_SPATIAL_SCALE = 8

# Latitudes of the latent rows' patch centers, (start, stop, num) for
# np.linspace.
LATENT_LAT_CENTERS = (-83.25, 84.75, 15)

SST_SURFACE_INDEX = SURFACE_VARIABLES.index("sea_surface_temperature")
SST_CHANNEL_INDEX = NUM_ATM_VARS * NUM_LEVELS + SST_SURFACE_INDEX  # 82


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


def channel_slices() -> Dict[str, slice]:
    """Each variable's slice of the 84-channel stack."""
    out = {v: slice(i * NUM_LEVELS, (i + 1) * NUM_LEVELS)
           for i, v in enumerate(ATM_VARIABLES)}
    base = NUM_ATM_VARS * NUM_LEVELS
    for i, v in enumerate(SURFACE_VARIABLES):
        out[v] = slice(base + i, base + i + 1)
    return out
