"""The CDS download requests of ``api/downloader.py``: one pressure-level
request (37 levels x 7 variables) and one single-level request (9
variables) per timestamp.

Counterpart of ``cra5_tpu/api/configs/era5_cds.py``, key for key.
"""

pressure_variables = dict(
    z="geopotential",
    q="specific_humidity",
    u="u_component_of_wind",
    v="v_component_of_wind",
    t="temperature",
    r="relative_humidity",
    w="vertical_velocity",
)

single_variables = dict(
    v10="10m_v_component_of_wind",
    u10="10m_u_component_of_wind",
    v100="100m_v_component_of_wind",
    u100="100m_u_component_of_wind",
    t2m="2m_temperature",
    tcc="total_cloud_cover",
    sp="surface_pressure",
    tp="total_precipitation",
    msl="mean_sea_level_pressure",
)

pressure_levels = [
    "1", "2", "3", "5", "7", "10", "20", "30", "50", "70",
    "100", "125", "150", "175", "200", "225", "250", "300", "350", "400",
    "450", "500", "550", "600", "650", "700", "750", "775", "800", "825",
    "850", "875", "900", "925", "950", "975", "1000",
]

grid = [0.25, 0.25]
data_format = "netcdf"
