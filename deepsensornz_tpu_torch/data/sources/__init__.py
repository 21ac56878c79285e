"""NZ data sources: ERA5(-Land), WRF forecasts, the station archive, the DEM."""

from deepsensornz_tpu_torch.data.sources.era5 import ERA5Source  # noqa: F401
from deepsensornz_tpu_torch.data.sources.stations import StationSource  # noqa: F401
from deepsensornz_tpu_torch.data.sources.topography import TopographySource  # noqa: F401
from deepsensornz_tpu_torch.data.sources.wrf import WRFSource  # noqa: F401
