"""Print the COCO sources and md5-verify the archives already on disk, the
port of ``examples/coco/download_datasets.py`` (the reference's
examples/coco/download_datasets.py). Nothing is fetched.

    python -m mask_rcnn_tpu_torch.examples.coco.download_datasets
"""


def main(argv=None):
    import argparse

    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    from mask_rcnn_tpu_torch.data import COCOInstanceSegmentationDataset

    try:
        COCOInstanceSegmentationDataset("train").download()
    except FileNotFoundError:
        for k, (url, md5) in (
            COCOInstanceSegmentationDataset.DOWNLOAD_URLS.items()
        ):
            print(f"{k}: {url}" + (f" (md5 {md5})" if md5 else ""))
        print("Place under ~/data/datasets/COCO/")


if __name__ == "__main__":
    main()
