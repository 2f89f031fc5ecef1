from . import planner, spectree
from .planner import GrowMap, plan_tree, build_grow_map
from .spectree import TreeEngine, tree_decode
