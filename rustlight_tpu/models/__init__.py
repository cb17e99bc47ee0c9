from .cbox import cornell_box
from .presets import (simple_sphere_scene, furnace_scene, door_box,
                      sphere_grid, sphere_grid_ao)
from .veach import veach_mis
