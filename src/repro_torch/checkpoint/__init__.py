from .io import all_steps, latest_step, load, restore, save
