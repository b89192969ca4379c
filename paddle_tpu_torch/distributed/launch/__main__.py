from . import launch

launch()
