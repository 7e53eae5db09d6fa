from .dataloader import DataLoader
from .dataset import CacheDataset, Dataset
from .folder_layout import FolderLayout
from .image_reader import NiftiReader
from .image_writer import ImageWriter, NiftiWriter, register_writer, resolve_writer
from .meta_image import MetaImage
from .nifti import read_nifti, write_nifti
from .synthetic import create_test_image_3d
from .utils import (collate_meta_tensor, compute_importance_map, decollate_batch, dense_patch_slices,
                    get_valid_patch_size, list_data_collate)
